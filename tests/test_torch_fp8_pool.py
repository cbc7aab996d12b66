"""The unscaled fp8 KV pool (``ModelConfig.kv_dtype = "float8_e4m3fn"``)
against the JAX package on the CPU.

The JAX package stores such a pool's pages with ``astype(float8_e4m3fn)``
(round to nearest even, NaN past +-464) and its Pallas kernels cast the
pages to float32 inside the kernel.  Inputs come from a numpy seed and go
through both packages; the JAX Pallas kernels run in interpret mode, as the
JAX package's own tests run them.  Tolerances:

  * ``cast_e4m3`` and every page write: bit for bit, NaN included;
  * attention outputs in float32: atol = rtol = 2e-5, the tolerance the JAX
    package holds its kernels to against their oracles (the online softmax
    sums in another order than the dense reference);
  * engines: greedy ids and counters equal (float32 weights, both engines
    on their CPU paths); decode logits over the fp8 pool keep a cosine of
    at least 0.98 with the model-dtype pool's, JAX's own bound
    (tests/test_quantize.py:test_fp8_kv_cache_decode_parity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
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
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
from k8s_llm_monitor_tpu_torch.ops.rope import rope_angles as t_rope_angles
from k8s_llm_monitor_tpu_torch.serving import engine as tengine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one intra-op thread, and many threads
    per test worker crowd the other workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-5, atol=2e-5)
THETA = 10_000.0
FP8 = "float8_e4m3fn"
# e4m3fn's rounding edge (448 is its largest value, 464 the midpoint to the
# NaN code), infinities, NaNs of both signs, subnormals and their halves.
EDGE = np.array([0.0, -0.0, 1.0, 448.0, 449.0, 460.0, 464.0,
                 np.nextafter(np.float32(464.0), np.float32(1e9)), 465.0,
                 470.0, 480.0, 500.0, -460.0, -464.0, -470.0, -500.0, 1e30,
                 np.inf, -np.inf, np.nan, -np.nan, 2.0 ** -9, 2.0 ** -10,
                 2.0 ** -10 * 1.0001, 3 * 2.0 ** -11, -1.5 * 2.0 ** -10,
                 2.0 ** -6, 2.0 ** -7, 1e-30], np.float32)


def _codes(x) -> np.ndarray:
    """Bytes of an fp8 array of either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _values(rng) -> np.ndarray:
    """EDGE, normals at three scales, every e4m3 binade, and raw float32
    bit patterns (NaNs, infinities and subnormals among them)."""
    scaled = (rng.uniform(-1, 1, 50_000)
              * 2.0 ** rng.integers(-14, 10, 50_000)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64)
    return np.concatenate([
        EDGE, (rng.standard_normal(100_000) * 3).astype(np.float32),
        (rng.standard_normal(20_000) * 200).astype(np.float32), scaled,
        bits.astype(np.uint32).view(np.float32)])


def _e4m3_pool(rng, num_blocks, bs, F):
    """An fp8 pool of normal(0, 2) rows in both packages' arrays."""
    x = (rng.standard_normal((num_blocks, bs, F)) * 2).astype(np.float32)
    j = jnp.asarray(x).astype(jnp.float8_e4m3fn)
    t = torch.from_numpy(_codes(j).copy()).view(torch.float8_e4m3fn)
    return t, j


# ---------------------------------------------------------- the cast


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_cast_e4m3_equals_jnp_astype(src):
    x = _values(np.random.default_rng(0))
    jx = jnp.asarray(x).astype(src)
    want = _codes(jx.astype(jnp.float8_e4m3fn))
    # The bf16 input bit for bit from jax (numpy has no bf16).
    tx = (torch.from_numpy(x) if src == "float32" else torch.from_numpy(
        np.asarray(jx).view(np.int16).copy()).view(torch.bfloat16))
    got = _codes(tllama.cast_e4m3(tx))
    assert (got == want).all(), np.nonzero(got != want)[0][:10]
    # Where torch's own cast saturates, the helper gives NaN as jnp does.
    sat = _codes(torch.from_numpy(EDGE).to(torch.float8_e4m3fn))
    assert (_codes(tllama.cast_e4m3(torch.from_numpy(EDGE)))
            != sat).sum() >= 10


def test_rounding_order_matters():
    """Rounding f32 -> bf16 -> fp8 is not f32 -> fp8 for a few percent of
    values: each write path keeps the JAX package's order (the XLA scatter
    rounds the model-dtype row, the fused kernel the f32 roped row)."""
    x = (np.random.default_rng(1).standard_normal(100_000) * 3).astype(
        np.float32)
    once = _codes(tllama.cast_e4m3(torch.from_numpy(x)))
    twice = _codes(tllama.cast_e4m3(torch.from_numpy(x).to(torch.bfloat16)))
    assert 0.01 < (once != twice).mean() < 0.06


def test_scatter_pages_writes_jnp_codes():
    rng = np.random.default_rng(2)
    B, S, KVH, D, bs = 2, 5, 2, 8, 4
    vals = (rng.standard_normal((B, S, KVH, D)) * 200).astype(np.float32)
    vals[0, 1, 0, :3] = [470.0, -np.inf, np.nan]
    table = np.asarray([[1, 2], [3, 4]], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    valid = np.asarray([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0]], bool)
    jp = jllama._scatter_pages(jnp.zeros((6, bs, KVH * D), jnp.float8_e4m3fn),
                               jnp.asarray(vals), jnp.asarray(table),
                               jnp.asarray(pos), jnp.asarray(valid))
    tp = tllama._scatter_pages(
        torch.zeros(6, bs, KVH * D, dtype=torch.float8_e4m3fn),
        torch.from_numpy(vals), torch.from_numpy(table),
        torch.from_numpy(pos.copy()), torch.from_numpy(valid))
    assert (_codes(tp) == _codes(jp)).all()


# ------------------------------------------------ plain versions vs Pallas


def test_flash_plain_on_fp8_pages_matches_pallas():
    # Fresh prefill, a continuation chunk at start > 0, an inactive lane,
    # and a lane ending one token below block alignment.
    rng = np.random.default_rng(3)
    B, S, KVH, D, qpk, bs, max_blocks, num_blocks = 4, 24, 2, 8, 2, 8, 8, 40
    starts, lengths = [0, 11, 27, 15], [24, 13, 0, 16]
    q = rng.standard_normal((B, S, KVH * qpk, D)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, num_blocks))[:max_blocks]
                       for _ in range(B)]).astype(np.int32)
    tk, jk = _e4m3_pool(rng, num_blocks, bs, KVH * D)
    tv, jv = _e4m3_pool(rng, num_blocks, bs, KVH * D)
    st, ln = np.asarray(starts, np.int32), np.asarray(lengths, np.int32)
    want = j_flash(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                   jnp.asarray(st), jnp.asarray(ln), interpret=True)
    got = pa.flash_prefill_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(st), torch.from_numpy(ln))
    for b, n in enumerate(lengths):          # rows past lengths are garbage
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(want)[b, :n],
                                   **TOL)


def _decode_case(seed, positions, H=8, KVH=2, D=16, bs=8, max_blocks=3):
    rng = np.random.default_rng(seed)
    B = len(positions)
    num_blocks = B * max_blocks + 2
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k_new = (rng.standard_normal((B, 1, KVH, D)) * 2).astype(np.float32)
    v_new = (rng.standard_normal((B, 1, KVH, D)) * 2).astype(np.float32)
    # Past e4m3's range: the appended row holds NaN codes there, as in JAX
    # (its softmax never reads a row it appends).
    k_new[1, 0, 0, :2] = [470.0, -500.0]
    v_new[2, 0, 1, :2] = [-480.0, 465.0]
    tk, jk = _e4m3_pool(rng, num_blocks, bs, KVH * D)
    tv, jv = _e4m3_pool(rng, num_blocks, bs, KVH * D)
    table = np.zeros((B, max_blocks), np.int32)
    nxt = 1
    for b, p in enumerate(positions):      # position 0: inactive, null row
        if p > 0:
            used = min(p // bs + 1, max_blocks)
            table[b, :used] = np.arange(nxt, nxt + used)
            nxt += used
    return (q, k_new, v_new, tk, jk, tv, jv, table,
            np.asarray(positions, np.int32))


def test_fused_plain_on_fp8_pages_matches_pallas():
    # An inactive lane (0), a page boundary (8), the last row of a block
    # (15), a mid-block position, and the rows the kernel appends.
    positions = [0, 8, 15, 21]
    q, k_new, v_new, tk, jk, tv, jv, table, pos = _decode_case(11, positions)
    D = q.shape[-1]
    jc, js = j_rope_angles(jnp.asarray(pos)[:, None], D, THETA)
    want = j_fused(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                   jc, js, jk, jv, jnp.asarray(table), jnp.asarray(pos),
                   interpret=True)
    tc, ts = t_rope_angles(torch.from_numpy(pos)[:, None], D, THETA)
    got = pa.paged_decode_attention_fused(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tc, ts, tk, tv, torch.from_numpy(table), torch.from_numpy(pos))
    assert got[1] is tk and got[2] is tv                   # in place
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    # The appended rows, the null block's included, bit for bit: both round
    # the f32 roped k (and the raw v) once, NaN past +-464.
    for i in (1, 2):
        assert (_codes(got[i]) == _codes(want[i])).all()
    # Lane 2's raw v row past +-464, appended at position 15 (block
    # table[2, 1], row 7), kv head 1: NaN codes, as JAX writes them.
    assert np.isnan(got[2][table[2, 1], 7, D:D + 2].float().numpy()).all()


@pytest.mark.parametrize("QS", [1, 4])
def test_split_plain_on_fp8_pages_matches_pallas(QS):
    rng = np.random.default_rng(20 + QS)
    B, KVH, qpk, D, bs, max_blocks, num_blocks = 5, 2, 2, 16, 8, 6, 40
    q = rng.standard_normal((B, QS, KVH * qpk, D)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, num_blocks))[:max_blocks]
                       for _ in range(B)]).astype(np.int32)
    tk, jk = _e4m3_pool(rng, num_blocks, bs, KVH * D)
    tv, jv = _e4m3_pool(rng, num_blocks, bs, KVH * D)
    if QS == 1:
        lengths = np.asarray([1, 8, 9, 30, 47], np.int32)
        want = j_paged_decode(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                              jnp.asarray(lengths), interpret=True)
        got = pa.paged_decode_attention_pallas(
            torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(lengths))
        rows = [1] * B
    else:
        starts = np.asarray([0, 5, 13, 30, 40], np.int32)
        rows = [4, 4, 2, 3, 0]
        want = j_paged_verify(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                              jnp.asarray(starts),
                              jnp.asarray(np.asarray(rows, np.int32)),
                              interpret=True)
        got = pa.paged_verify_attention_pallas(
            torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(starts), torch.tensor(rows, dtype=torch.int32))
    for b, n in enumerate(rows):             # rows past qlens are garbage
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(want)[b, :n],
                                   **TOL)


# -------------------------------------------------------- config, pool


# B9's remainder: float32 pages, and bf16 pages under a float32 model
# (float8_e5m2 and float16 pages are ported, tests/test_torch_kv_dtypes.py).
@pytest.mark.parametrize("kv_dtype,dtype", [("float32", "bfloat16"),
                                            ("bfloat16", "float32")])
def test_other_page_dtypes_name_b9(kv_dtype, dtype):
    with pytest.raises(NotImplementedError, match="B9"):
        ModelConfig(kv_dtype=kv_dtype, dtype=dtype)


def test_pool_dtype_and_the_scaled_tier_wins():
    cfg = ModelConfig(kv_dtype=FP8)
    assert ModelConfig(kv_dtype="bfloat16").torch_kv_dtype == torch.bfloat16
    pages = tllama.init_kv_pages(cfg, 4, 8, "cpu", torch.bfloat16)
    assert pages.k[0].dtype == torch.float8_e4m3fn and not pages.quantized
    # kv_quant set: the scaled tier, as in JAX (models/llama.py:140-151).
    pages = tllama.init_kv_pages(cfg, 4, 8, "cpu", kv_quant="int8")
    assert pages.k[0].dtype == torch.int8 and pages.quantized


CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=1e4)
ECFG_KW = dict(max_slots=2, num_blocks=64, block_size=8, max_blocks_per_seq=16,
               prefill_buckets=(16,))


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ModelConfig(**CFG_KW), device="cpu")
    return params, model


def _prompts():
    rng = np.random.default_rng(0)
    # One bucket, a prompt past the top bucket (chunked: its chunks read
    # the fp8 pages back) and one over capacity (tail-truncated).
    return [[int(t) for t in rng.integers(3, 300, size=n)]
            for n in (4, 11, 40, 150, 16)]


def test_fp8_pool_engine_matches_jax_engine(weights):
    want_eng = jengine.InferenceEngine(
        JModelConfig(kv_dtype=FP8, **CFG_KW), weights[0],
        jengine.EngineConfig(**ECFG_KW), eos_id=-1)
    want = want_eng.generate(_prompts(), jengine.SamplingParams(max_tokens=6))
    cfg = ModelConfig(kv_dtype=FP8, **CFG_KW)
    eng = tengine.InferenceEngine(cfg, weights[1],
                                  tengine.EngineConfig(**ECFG_KW), eos_id=-1,
                                  device="cpu")
    got = eng.generate(_prompts(), tengine.SamplingParams(max_tokens=6))
    assert eng.kv_quant == "" and eng.pages.k[0].dtype == torch.float8_e4m3fn
    assert (eng.prefill_path, eng.decode_path) == ("dense", "gather")
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert eng.steps == want_eng.steps
    # One byte per element: a quarter of the float32 toy's pool.
    assert eng.pool_bytes == eng.pages.nbytes() == want_eng.kv_tier_stats()[
        "device_bytes"]
    js, ts = want_eng.kv_tier_stats(), eng.kv_tier_stats()
    assert ts == js and ts["page_dtype"] == FP8
    assert tengine.InferenceEngine(
        ModelConfig(**CFG_KW), weights[1], tengine.EngineConfig(**ECFG_KW),
        device="cpu").pool_bytes == 4 * eng.pool_bytes


def test_fp8_pool_decode_logits_track_the_model_dtype_pool(weights):
    """The JAX package's fp8 parity check on both packages: one decode step
    after a 12-token prefill, logits over fp8 pages against the float32
    pool's (cosine > 0.98), and the port's fp8 logits against JAX's."""
    rng = np.random.default_rng(9)
    prompt = [int(t) for t in rng.integers(3, 250, size=12)]
    jtable = jnp.asarray([[1, 2, 0, 0, 0, 0, 0, 0]], jnp.int32)
    ttable = torch.tensor([[1, 2, 0, 0, 0, 0, 0, 0]], dtype=torch.int32)

    def jax_logits(cfg):
        pages = jllama.init_kv_pages(cfg, 16, 8)
        _, pages = jllama.prefill(weights[0], cfg, jnp.asarray([prompt]),
                                  jnp.asarray([12], jnp.int32), pages, jtable)
        out, _ = jllama.decode_step(weights[0], cfg,
                                    jnp.asarray([prompt[-1]], jnp.int32),
                                    jnp.asarray([12], jnp.int32), pages,
                                    jtable)
        return np.asarray(out[0])

    def port_logits(cfg, **impls):
        model = weights[1]
        model_cfg, model.cfg = model.cfg, cfg
        try:
            pages = tllama.init_kv_pages(cfg, 16, 8, "cpu")
            tllama.prefill(model, torch.tensor([prompt]),
                           torch.tensor([12], dtype=torch.int32), pages,
                           ttable, attn_impl=impls.get("prefill"))
            out, _ = tllama.decode_step(
                model, torch.tensor([prompt[-1]]),
                torch.tensor([12], dtype=torch.int32), pages, ttable,
                attn_impl=impls.get("decode",
                                    tengine.paged_decode_attention))
        finally:
            model.cfg = model_cfg
        return out[0].numpy()

    ref = jax_logits(JModelConfig(**CFG_KW))
    j8 = jax_logits(JModelConfig(kv_dtype=FP8, **CFG_KW))
    t8 = port_logits(ModelConfig(kv_dtype=FP8, **CFG_KW))
    # The kernels' plain versions: flash prefill, fused decode.
    t8k = port_logits(ModelConfig(kv_dtype=FP8, **CFG_KW),
                      prefill=pa.flash_prefill_attention,
                      decode=pa.paged_decode_attention_fused)
    cos = (ref * t8).sum() / (np.linalg.norm(ref) * np.linalg.norm(t8))
    assert cos > 0.98, cos
    np.testing.assert_allclose(t8, j8, rtol=1e-4, atol=1e-4)
    cosk = (ref * t8k).sum() / (np.linalg.norm(ref) * np.linalg.norm(t8k))
    assert cosk > 0.98, cosk
