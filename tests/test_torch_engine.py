"""The port's InferenceEngine against the JAX engine on the CPU.

Same float32 weights (params_from_jax), a 2-slot engine over a 64-block
pool with one 16-token bucket, greedy ids compared exactly: mixed prompt
lengths, a prompt longer than the top bucket (chunked prefill), a prompt
over capacity (tail truncation), EOS retirement and max_tokens.  Sampled
lanes use a torch.Generator, whose bits differ from jax.random's, so they
are checked for reproducibility and bounds only.
"""

import jax
import numpy as np
import pytest

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=1e4)
ECFG_KW = dict(max_slots=2, num_blocks=64, block_size=8, max_blocks_per_seq=16,
               prefill_buckets=(16,))
MAX_TOKENS = 6


def _prompts():
    rng = np.random.default_rng(0)
    # 4 and 11: one bucket; 40: > top bucket 16 (chunked); 150: over the
    # 128-token capacity with max_tokens (tail-truncated); 16: one bucket
    # exactly.
    return [[int(t) for t in rng.integers(3, 300, size=n)]
            for n in (4, 11, 40, 150, 16)]


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    tree = jax.tree.map(np.asarray, params)
    model = params_from_jax(tree, ModelConfig(**CFG_KW), device="cpu")
    return params, model


def _jax_run(params, eos_id, prompts):
    eng = jengine.InferenceEngine(JModelConfig(**CFG_KW), params,
                                  jengine.EngineConfig(**ECFG_KW),
                                  eos_id=eos_id)
    return eng.generate(prompts, jengine.SamplingParams(max_tokens=MAX_TOKENS))


def _port_engine(model, eos_id=-1, seed=0):
    return tengine.InferenceEngine(ModelConfig(**CFG_KW), model,
                                   tengine.EngineConfig(**ECFG_KW),
                                   eos_id=eos_id, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def jax_greedy(weights):
    return _jax_run(weights[0], -1, _prompts())


def test_greedy_ids_match_jax_engine(weights, jax_greedy):
    port = _port_engine(weights[1]).generate(
        _prompts(), tengine.SamplingParams(max_tokens=MAX_TOKENS))
    assert [r.token_ids for r in port] == [r.token_ids for r in jax_greedy]
    assert all(r.finish_reason == "length" and len(r.token_ids) == MAX_TOKENS
               for r in port)


def test_eos_retirement_matches_jax_engine(weights, jax_greedy):
    # EOS = the third token the first prompt generates: that request must
    # retire early with reason "eos", the others wherever EOS shows up.
    eos = jax_greedy[0].token_ids[2]
    want = _jax_run(weights[0], eos, _prompts())
    got = _port_engine(weights[1], eos_id=eos).generate(
        _prompts(), tengine.SamplingParams(max_tokens=MAX_TOKENS))
    assert [(r.token_ids, r.finish_reason) for r in got] == [
        (r.token_ids, r.finish_reason) for r in want]
    assert got[0].finish_reason == "eos" and len(got[0].token_ids) <= 2


def test_capacity_truncation_keeps_the_tail(weights):
    eng = _port_engine(weights[1])
    req = tengine.GenerationRequest("r", list(range(3, 153)),
                                    tengine.SamplingParams(max_tokens=6))
    eng.submit(req)
    assert eng.capacity_tokens == 128
    assert req.prompt_ids == list(range(3, 153))[150 + 6 - 128:]
    req2 = tengine.GenerationRequest("r2", [5], tengine.SamplingParams(
        max_tokens=1000))
    eng.submit(req2)
    assert req2.sampling.max_tokens == 127


def test_sampled_lanes_reproducible_and_in_bounds(weights):
    sp = tengine.SamplingParams(max_tokens=MAX_TOKENS, temperature=0.8,
                                top_k=20, top_p=0.9)
    runs = [_port_engine(weights[1], seed=7).generate(_prompts()[:3], sp)
            for _ in range(2)]
    assert [r.token_ids for r in runs[0]] == [r.token_ids for r in runs[1]]
    for r in runs[0]:
        assert len(r.token_ids) == MAX_TOKENS
        assert all(0 <= t < 300 for t in r.token_ids)


def test_cancel_and_generate_text(weights):
    eng = _port_engine(weights[1])
    for rid in ("a", "b", "c"):
        eng.submit(tengine.GenerationRequest(rid, [5, 6, 7]))
    assert eng.cancel("c")                     # still pending: fails now
    assert eng._results["c"].finish_reason == "error"
    eng.step()                                 # a and b now hold the slots
    assert eng.cancel("a")
    while eng.has_work:
        eng.step()
    assert (len(eng._results["a"].token_ids)
            < len(eng._results["b"].token_ids))
    assert not eng.cancel("missing")
    text_eng = tengine.InferenceEngine(
        ModelConfig(**CFG_KW), weights[1], tengine.EngineConfig(**ECFG_KW),
        tokenizer=ByteTokenizer(), device="cpu")
    assert isinstance(text_eng.generate_text(
        "why crashloop?", tengine.SamplingParams(max_tokens=4)), str)


# ------------------------------------------- quantized pool, split decode


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_pool_greedy_ids_match_jax_engine(weights, kv_dtype):
    # On the CPU both engines prefill densely (fresh prompts attend to the
    # in-flight K/V, chunks to the dequantized pages) and decode through
    # the gather/dequant path; the pools quantize alike, so the ids agree.
    want = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), weights[0],
        jengine.EngineConfig(kv_dtype=kv_dtype, **ECFG_KW), eos_id=-1
    ).generate(_prompts(), jengine.SamplingParams(max_tokens=MAX_TOKENS))
    eng = tengine.InferenceEngine(
        ModelConfig(**CFG_KW), weights[1],
        tengine.EngineConfig(kv_dtype=kv_dtype, **ECFG_KW), eos_id=-1,
        device="cpu")
    got = eng.generate(_prompts(), tengine.SamplingParams(max_tokens=MAX_TOKENS))
    assert eng.kv_quant == kv_dtype and eng.pages.quantized
    assert (eng.prefill_path, eng.decode_path) == ("dense", "gather")
    assert [r.token_ids for r in got] == [r.token_ids for r in want]


def test_pallas_decode_path_matches_gather(weights):
    ids = {}
    for path in ("pallas", "gather"):
        eng = tengine.InferenceEngine(
            ModelConfig(**CFG_KW), weights[1],
            tengine.EngineConfig(decode_path=path, **ECFG_KW), device="cpu")
        assert eng.decode_path == path
        ids[path] = [r.token_ids for r in eng.generate(
            _prompts(), tengine.SamplingParams(max_tokens=MAX_TOKENS))]
    assert ids["pallas"] == ids["gather"]


@pytest.mark.parametrize("kv_dtype,kv_quant", [
    ("auto", ""), ("bf16", ""), ("fp16", ""), ("none", ""), ("int8", "int8"),
    ("fp8", "fp8")])
def test_kv_dtype_resolution_and_pool_bytes(weights, kv_dtype, kv_quant):
    eng = tengine.InferenceEngine(
        ModelConfig(**CFG_KW), weights[1],
        tengine.EngineConfig(kv_dtype=kv_dtype, **ECFG_KW), device="cpu")
    assert eng.kv_quant == kv_quant
    assert eng.pool_bytes == eng.pages.nbytes()
    if kv_quant:
        # 1-byte codes plus one float32 scale per (token, head): the
        # float32 toy holds 128 / 48 = 2.67x the tokens in the same bytes.
        assert eng.pool_bytes * 128 == 48 * tengine.InferenceEngine(
            ModelConfig(**CFG_KW), weights[1],
            tengine.EngineConfig(**ECFG_KW), device="cpu").pool_bytes


def test_quant_pool_with_pallas_decode_takes_gather(weights):
    eng = tengine.InferenceEngine(
        ModelConfig(**CFG_KW), weights[1],
        tengine.EngineConfig(kv_dtype="int8", decode_path="pallas", **ECFG_KW),
        device="cpu")
    assert eng.decode_path == "gather"
    with pytest.raises(ValueError):
        tengine.InferenceEngine(
            ModelConfig(**CFG_KW), weights[1],
            tengine.EngineConfig(kv_dtype="int4", **ECFG_KW), device="cpu")
