"""Unscaled ``float8_e5m2`` and ``float16`` KV pools
(``ModelConfig.kv_dtype``) against the JAX package on the CPU.

The JAX package stores such a pool's pages with ``astype`` and its Pallas
kernels cast the pages to float32 inside the kernel.  Inputs come from a
numpy seed and go through both packages; the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them.  Tolerances:

  * ``cast_e5m2``, the fp16 cast and every page write: bit for bit (from
    float32 NaN included; XLA's CPU conversion from bfloat16 writes 0x7F
    for every NaN, which ``cast_e5m2`` does not copy);
  * attention outputs in float32: atol = rtol = 2e-5, the tolerance the JAX
    package holds its kernels to against their oracles;
  * engines: greedy ids and counters equal (float32 weights, both engines
    on their CPU paths); the host tier and KVX1 blobs byte for byte.
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
from k8s_llm_monitor_tpu.resilience import faults as jfaults
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.ops import attention as tattn
from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
from k8s_llm_monitor_tpu_torch.ops.rope import rope_angles as t_rope_angles
from k8s_llm_monitor_tpu_torch.resilience import faults as tfaults
from k8s_llm_monitor_tpu_torch.resilience.tenancy import DEFAULT_TENANT as TEN
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
KV_DTYPES = ("float8_e5m2", "float16")
# e5m2's edge (57344 its largest value, 61440 the midpoint to infinity,
# subnormals from 2^-16) and fp16's (65504, 65520; subnormals from 2^-24),
# infinities, NaNs of both signs.
EDGE = np.array([0.0, -0.0, 1.0, 57344.0, 57345.0, 59000.0, 61439.0,
                 np.nextafter(np.float32(61440.0), np.float32(0.0)), 61440.0,
                 61441.0, 65504.0, 65519.0, 65520.0, 65521.0, 70000.0,
                 -57344.0, -61440.0, -65520.0, 1e30, np.inf, -np.inf, np.nan,
                 -np.nan, 2.0 ** -14, 2.0 ** -16, 2.0 ** -17,
                 2.0 ** -17 * 1.0001, 3 * 2.0 ** -18, 2.0 ** -24, 2.0 ** -25,
                 3 * 2.0 ** -26, -1.5 * 2.0 ** -24, 1e-30], np.float32)
BITS = {"float8_e5m2": np.uint8, "float16": np.uint16}


def _bits(x) -> np.ndarray:
    """Bytes of a page array of either package, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        view = torch.uint8 if x.element_size() == 1 else torch.int16
        return x.view(view).numpy().view(BITS[str(x.dtype)[6:]])
    return np.asarray(x).view(BITS[str(x.dtype)])


def _values(rng) -> np.ndarray:
    """EDGE, normals at three scales, every binade of both formats, and raw
    float32 bit patterns (NaNs, infinities and subnormals among them)."""
    scaled = (rng.uniform(-1, 1, 50_000)
              * 2.0 ** rng.integers(-27, 17, 50_000)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64)
    return np.concatenate([
        EDGE, (rng.standard_normal(100_000) * 3).astype(np.float32),
        (rng.standard_normal(20_000) * 20_000).astype(np.float32), scaled,
        bits.astype(np.uint32).view(np.float32)])


def _port_cast(kv_dtype):
    return (tllama.cast_e5m2 if kv_dtype == "float8_e5m2"
            else (lambda x: x.to(torch.float16)))


# ---------------------------------------------------------- the casts


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_cast_equals_jnp_astype(kv_dtype, src):
    x = _values(np.random.default_rng(0))
    jx = jnp.asarray(x).astype(src)
    want = _bits(jx.astype(kv_dtype))
    tx = (torch.from_numpy(x) if src == "float32" else torch.from_numpy(
        np.asarray(jx).view(np.int16).copy()).view(torch.bfloat16))
    got = _bits(_port_cast(kv_dtype)(tx))
    nan = np.isnan(x if src == "float32" else np.asarray(jx, np.float32))
    if src == "float32":
        # NaN included: jnp writes 0x7E (e5m2) / 0x7E00 (fp16) with the
        # sign, where torch's e5m2 cast writes 0x7F.
        assert (got == want).all(), np.nonzero(got != want)[0][:10]
    else:
        # From bf16, XLA's CPU conversion writes one NaN code for every
        # NaN; both are NaN, every other value bit for bit.
        assert (got[~nan] == want[~nan]).all()
        assert np.isnan(_port_cast(kv_dtype)(tx)[torch.from_numpy(nan)]
                        .float().numpy()).all()
    if kv_dtype == "float8_e5m2" and src == "float32":
        raw = _bits(torch.from_numpy(EDGE).to(torch.float8_e5m2))
        assert (raw != _bits(tllama.cast_e5m2(torch.from_numpy(EDGE)))).sum(
            ) == 2                                    # the two NaNs
        assert set(got[nan]) == {0x7E, 0xFE}


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_scatter_pages_writes_jnp_codes(kv_dtype):
    rng = np.random.default_rng(2)
    B, S, KVH, D, bs = 2, 5, 2, 8, 4
    vals = (rng.standard_normal((B, S, KVH, D)) * 30_000).astype(np.float32)
    vals[0, 1, 0, :4] = [61440.0, -np.inf, 65520.0, 2.0 ** -25]
    table = np.asarray([[1, 2], [3, 4]], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    valid = np.asarray([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0]], bool)
    jp = jllama._scatter_pages(jnp.zeros((6, bs, KVH * D), kv_dtype),
                               jnp.asarray(vals), jnp.asarray(table),
                               jnp.asarray(pos), jnp.asarray(valid))
    tp = tllama._scatter_pages(
        torch.zeros(6, bs, KVH * D, dtype=getattr(torch, kv_dtype)),
        torch.from_numpy(vals), torch.from_numpy(table),
        torch.from_numpy(pos.copy()), torch.from_numpy(valid))
    assert (_bits(tp) == _bits(jp)).all()


# ------------------------------------------------ plain versions vs Pallas


def _pool(rng, num_blocks, bs, F, kv_dtype):
    """A pool of normal(0, 2) rows in both packages' arrays."""
    x = (rng.standard_normal((num_blocks, bs, F)) * 2).astype(np.float32)
    j = jnp.asarray(x).astype(kv_dtype)
    t = torch.from_numpy(_bits(j).copy())
    t = (t.view(torch.float8_e5m2) if kv_dtype == "float8_e5m2"
         else t.view(torch.int16).view(torch.float16))
    return t, j


def test_pool_helper_is_byte_exact():
    rng = np.random.default_rng(0)
    for kv in KV_DTYPES:
        t, j = _pool(rng, 3, 4, 8, kv)
        assert t.dtype == getattr(torch, kv) and (_bits(t) == _bits(j)).all()


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_flash_plain_matches_pallas(kv_dtype):
    # Fresh prefill, a continuation chunk at start > 0, an inactive lane,
    # and a lane ending one token below block alignment.
    rng = np.random.default_rng(3)
    B, S, KVH, D, qpk, bs, max_blocks, num_blocks = 4, 24, 2, 8, 2, 8, 8, 40
    starts, lengths = [0, 11, 27, 15], [24, 13, 0, 16]
    q = rng.standard_normal((B, S, KVH * qpk, D)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, num_blocks))[:max_blocks]
                       for _ in range(B)]).astype(np.int32)
    tk, jk = _pool(rng, num_blocks, bs, KVH * D, kv_dtype)
    tv, jv = _pool(rng, num_blocks, bs, KVH * D, kv_dtype)
    st, ln = np.asarray(starts, np.int32), np.asarray(lengths, np.int32)
    want = j_flash(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                   jnp.asarray(st), jnp.asarray(ln), interpret=True)
    got = pa.flash_prefill_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(st), torch.from_numpy(ln))
    for b, n in enumerate(lengths):          # rows past lengths are garbage
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(want)[b, :n],
                                   **TOL)


def _decode_case(seed, positions, kv_dtype, H=8, KVH=2, D=16, bs=8,
                 max_blocks=3):
    rng = np.random.default_rng(seed)
    B = len(positions)
    num_blocks = B * max_blocks + 2
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k_new = (rng.standard_normal((B, 1, KVH, D)) * 2).astype(np.float32)
    v_new = (rng.standard_normal((B, 1, KVH, D)) * 2).astype(np.float32)
    # Past each format's range and into its subnormals: the appended rows
    # hold infinities and subnormal codes there, as in JAX (its softmax
    # folds the current token from the f32 row).
    k_new[1, 0, 0, :3] = [61440.0, -70000.0, 2.0 ** -17]
    v_new[2, 0, 1, :3] = [-65520.0, 65536.0, 2.0 ** -15]
    tk, jk = _pool(rng, num_blocks, bs, KVH * D, kv_dtype)
    tv, jv = _pool(rng, num_blocks, bs, KVH * D, kv_dtype)
    table = np.zeros((B, max_blocks), np.int32)
    nxt = 1
    for b, p in enumerate(positions):      # position 0: inactive, null row
        if p > 0:
            used = min(p // bs + 1, max_blocks)
            table[b, :used] = np.arange(nxt, nxt + used)
            nxt += used
    return (q, k_new, v_new, tk, jk, tv, jv, table,
            np.asarray(positions, np.int32))


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_fused_plain_matches_pallas(kv_dtype):
    # An inactive lane (0), a page boundary (8), the last row of a block
    # (15), a mid-block position, and the rows the kernel appends.
    positions = [0, 8, 15, 21]
    q, k_new, v_new, tk, jk, tv, jv, table, pos = _decode_case(
        11, positions, kv_dtype)
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
    # the f32 roped k (and the raw v) once.
    for i in (1, 2):
        assert (_bits(got[i]) == _bits(want[i])).all()
    # Lane 2's raw v row past the range, appended at position 15 (block
    # table[2, 1], row 7), kv head 1: infinities, and a subnormal both
    # formats hold, as JAX writes them.
    row = got[2][table[2, 1], 7, D:D + 3].float().numpy()
    assert np.isinf(row[:2]).all() and row[2] == 2.0 ** -15


@pytest.mark.parametrize("QS", [1, 4])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_split_plain_matches_pallas(kv_dtype, QS):
    rng = np.random.default_rng(20 + QS)
    B, KVH, qpk, D, bs, max_blocks, num_blocks = 5, 2, 2, 16, 8, 6, 40
    q = rng.standard_normal((B, QS, KVH * qpk, D)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, num_blocks))[:max_blocks]
                       for _ in range(B)]).astype(np.int32)
    tk, jk = _pool(rng, num_blocks, bs, KVH * D, kv_dtype)
    tv, jv = _pool(rng, num_blocks, bs, KVH * D, kv_dtype)
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


def test_widen_pages_is_exact():
    """The CPU readers widen e5m2 to bf16 (it holds every e5m2 value) and
    fp16 to float32: bf16 would drop 3 of fp16's 10 mantissa bits."""
    x = torch.from_numpy(_values(np.random.default_rng(5))[:200_000])
    x = x[torch.isfinite(x)]
    for dtype, wide in ((torch.float8_e5m2, torch.bfloat16),
                        (torch.float16, torch.float32)):
        pages = x.to(dtype)
        got = tattn.widen_pages(pages)
        assert got.dtype == wide
        assert torch.equal(got.float(), pages.float())
    assert (x.to(torch.float16).to(torch.bfloat16).float()
            != x.to(torch.float16).float()).any()


# -------------------------------------------------------- config, pool


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_config_takes_the_pool(kv_dtype, dtype):
    cfg = ModelConfig(kv_dtype=kv_dtype, dtype=dtype)
    assert cfg.torch_kv_dtype == getattr(torch, kv_dtype)
    pages = tllama.init_kv_pages(cfg, 4, 8, "cpu")
    assert pages.k[0].dtype == getattr(torch, kv_dtype)
    assert not pages.quantized
    # kv_quant set: the scaled tier wins, as in JAX (models/llama.py:140).
    assert tllama.init_kv_pages(cfg, 4, 8, "cpu", kv_quant="int8").quantized


CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=THETA)
ECFG_KW = dict(max_slots=2, num_blocks=64, block_size=8, max_blocks_per_seq=16,
               prefill_buckets=(16,))


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ModelConfig(**CFG_KW), device="cpu")
    return params, model


@pytest.fixture(autouse=True)
def _deterministic(monkeypatch):
    """Both fault injectors reset; the JAX engine's calls read as ready
    unless stuck (the port's CPU calls are done when they return)."""
    jfaults.get_injector().reset(seed=1234)
    tfaults.get_injector().reset(seed=1234)
    monkeypatch.setattr(
        jengine.InferenceEngine, "_call_ready",
        staticmethod(lambda call: not isinstance(call.arr,
                                                 jengine._StuckPayload)))
    yield
    jfaults.get_injector().reset()
    tfaults.get_injector().reset()


def _engines(weights, kv_dtype, **over):
    kw = dict(ECFG_KW, **over)
    j = jengine.InferenceEngine(JModelConfig(kv_dtype=kv_dtype, **CFG_KW),
                                weights[0], jengine.EngineConfig(**kw),
                                eos_id=-1)
    t = tengine.InferenceEngine(ModelConfig(kv_dtype=kv_dtype, **CFG_KW),
                                weights[1], tengine.EngineConfig(**kw),
                                eos_id=-1, device="cpu")
    return j, t


def _prompts():
    rng = np.random.default_rng(0)
    # One bucket, a prompt past the top bucket (chunked: its chunks read
    # the pages back) and one over capacity (tail-truncated).
    return [[int(t) for t in rng.integers(3, 300, size=n)]
            for n in (4, 11, 40, 150, 16)]


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_engine_matches_jax_engine(weights, kv_dtype):
    j, t = _engines(weights, kv_dtype)
    want = j.generate(_prompts(), jengine.SamplingParams(max_tokens=6))
    got = t.generate(_prompts(), tengine.SamplingParams(max_tokens=6))
    assert t.kv_quant == "" and t.pages.k[0].dtype == getattr(torch, kv_dtype)
    assert (t.prefill_path, t.decode_path) == ("dense", "gather")
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert t.steps == j.steps
    js, ts = j.kv_tier_stats(), t.kv_tier_stats()
    assert ts == js and ts["page_dtype"] == kv_dtype
    # A quarter (e5m2) or half (fp16) of the float32 toy's pool.
    per = 1 if kv_dtype == "float8_e5m2" else 2
    assert t.pool_bytes == t.pages.nbytes() == js["device_bytes"]
    assert tengine.InferenceEngine(
        ModelConfig(**CFG_KW), weights[1], tengine.EngineConfig(**ECFG_KW),
        device="cpu").pool_bytes == (4 // per) * t.pool_bytes


def test_pool_bytes_at_llama3_8b():
    """2,048 B per token and layer on e5m2 pages at Llama-3-8B's 8 kv heads
    of 128, 4,096 B on fp16 pages (bf16's)."""
    from k8s_llm_monitor_tpu_torch.serving.kv_cache import page_slice_bytes

    for kv_dtype, per_token in (("float8_e5m2", 2048), ("float16", 4096)):
        nbytes = torch.empty(0, dtype=getattr(torch, kv_dtype)).element_size()
        assert page_slice_bytes(8, 128, 1, nbytes) == per_token


# ------------------------------------------------- the host tier, KVX1


def _ids(eng, sp_mod, prompt, n):
    r = eng.generate([list(prompt)], sp_mod.SamplingParams(max_tokens=n))[0]
    assert r.finish_reason == "length", r
    return r.token_ids


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_spill_restore_matches_jax_engine(weights, kv_dtype):
    """tests/test_kv_tier.py's scenario (a 14-block pool cycling six
    24-token prompts twice) on both engines: ids, spills, restores and the
    host tier's bytes equal."""
    j, t = _engines(weights, kv_dtype, max_slots=2, num_blocks=14,
                    prefill_buckets=(32,), host_spill_bytes=64 << 20)
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(3, 300, size=24)) for _ in range(6)]
    for _ in range(2):
        for i, p in enumerate(prompts):
            assert _ids(t, tengine, p, 4) == _ids(j, jengine, p, 4), i
    js, ts = j.kv_tier_stats(), t.kv_tier_stats()
    assert ts["spills"] > 0 and ts["restores"] > 0, ts
    for key in ("spills", "restores", "host_bytes", "host_entries",
                "host_lost", "page_dtype", "device_bytes"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_kvx1_blob_round_trips_across_packages(weights, kv_dtype):
    """A prefix exported by the JAX engine installs into the port's and
    back: the receiver's ids equal the owner's, and its export is the
    owner's blob bit for bit."""
    prompt = [int(x) for x in np.random.default_rng(9).integers(3, 300,
                                                                size=24)]
    j, t = _engines(weights, kv_dtype)
    want = _ids(j, jengine, prompt, 5)
    blob = j.export_prefix(list(prompt), tenant=TEN)
    assert blob is not None and blob[:4] == b"KVX1"
    assert t.install_prefix(blob, expected_tenant=TEN) == "installed"
    assert _ids(t, tengine, prompt, 5) == want
    assert t.export_prefix(list(prompt), tenant=TEN) == blob
    j2, _ = _engines(weights, kv_dtype)
    assert j2.install_prefix(t.export_prefix(list(prompt), tenant=TEN),
                             expected_tenant=TEN) == "installed"
    assert _ids(j2, jengine, prompt, 5) == want
