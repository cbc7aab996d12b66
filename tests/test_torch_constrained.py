"""Grammar-constrained decoding in the port's engine against the JAX engine.

Same float32 weights (params_from_jax), the verdict grammar's token FSM
installed on both engines (``set_grammar(verdict_fsm(...))``), greedy ids
compared exactly: a lone constrained lane, a batch mixing free and
constrained lanes, a prompt longer than the top bucket (its first token
comes from the final chunk round), and a free request in a slot whose
previous occupant was constrained (it must start at the FREE state).
Sampled constrained decoding is checked on the port alone: at the six
sampling settings of the JAX package's constrained fuzz test, every sample
parses as a verdict.
"""

import jax
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.diagnosis.grammar import verdict_fsm as jverdict_fsm
from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.diagnosis.grammar import (
    parse_verdict,
    verdict_fsm,
)
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one intra-op thread, and many threads
    per test worker crowd the other workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=1e4)
# 1024 tokens per sequence: the longest verdict (469 tokens) and any prompt
# here fit, so no verdict is cut.  One 32-token bucket keeps the JAX
# engine's compiles few; a longer prompt is chunked.
ECFG_KW = dict(max_slots=2, num_blocks=256, block_size=16,
               max_blocks_per_seq=64, prefill_buckets=(32,),
               decode_steps_per_iter=8)
TOK = ByteTokenizer()


def _prompts():
    rng = np.random.default_rng(7)
    question = TOK.encode("## Question\nwhy is default/web crashlooping?\n")
    return {
        "a": question,
        "b": [int(t) for t in rng.integers(3, 259, size=11)],
        "c": TOK.encode("status of kube-system/dns?"),
        "long": [int(t) for t in rng.integers(3, 259, size=80)],
    }


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_jax(tree, ModelConfig(**CFG_KW), device="cpu")


@pytest.fixture(scope="module")
def jax_engine(weights):
    eng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), weights[0],
        jengine.EngineConfig(prefix_cache_entries=0, **ECFG_KW),
        tokenizer=TOK)
    eng.set_grammar(jverdict_fsm(eos_id=TOK.eos_id))
    return eng


def _port_engine(model, grammar=True):
    # The prefix cache off, as in the JAX engine the tests compare with.
    eng = tengine.InferenceEngine(ModelConfig(**CFG_KW), model,
                                  tengine.EngineConfig(prefix_cache_entries=0,
                                                       **ECFG_KW),
                                  tokenizer=TOK, device="cpu")
    if grammar:
        eng.set_grammar(verdict_fsm(eos_id=TOK.eos_id))
    return eng


def _run(mod, eng, reqs):
    """Submit ``reqs`` ((id, prompt, constrained) triples, greedy) to one
    engine together and step it to completion; results by id."""
    for rid, prompt, constrained in reqs:
        eng.submit(mod.GenerationRequest(rid, list(prompt), mod.SamplingParams(
            max_tokens=1 if constrained else 12, constrained=constrained)))
    while eng.has_work:
        eng.step()
    return {rid: eng.poll(rid) for rid, _, _ in reqs}


def _ids(results):
    return {rid: (r.token_ids, r.finish_reason) for rid, r in results.items()}


CASES = {
    "lone": [("a", "a", True)],
    "mixed": [("b", "b", False), ("a", "a", True)],
    "chunked": [("long", "long", True)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_constrained_greedy_ids_match_jax_engine(weights, jax_engine, case):
    p = _prompts()
    reqs = [(rid, p[key], c) for rid, key, c in CASES[case]]
    want = _run(jengine, jax_engine, reqs)
    got = _run(tengine, _port_engine(weights[1]), reqs)
    assert _ids(got) == _ids(want)
    for rid, _, constrained in reqs:
        if constrained:
            assert got[rid].finish_reason == "eos"
            parse_verdict(TOK.decode(got[rid].token_ids))


def test_free_lane_in_a_reused_constrained_slot(weights, jax_engine):
    """A constrained request ends in slot 0 at an accepting state; a free
    request then admitted into slot 0 must decode from the FREE state: its
    ids equal the JAX engine's and a fresh engine's."""
    p = _prompts()
    eng = _port_engine(weights[1])
    first = _run(tengine, eng, [("a", p["a"], True)])
    assert int(eng._fsm_state[0]) > 0
    reused = _run(tengine, eng, [("c", p["c"], False)])
    fresh = _run(tengine, _port_engine(weights[1]), [("c", p["c"], False)])
    want = _run(jengine, jax_engine, [("c", p["c"], False)])
    parse_verdict(TOK.decode(first["a"].token_ids))
    assert _ids(reused) == _ids(fresh) == _ids(want)
    assert int(eng._fsm_state[0]) == 0


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0),     # greedy
    (0.7, 0, 1.0),
    (1.0, 50, 1.0),    # top-k (the bounded sampler)
    (1.3, 0, 0.9),     # top-p
    (0.9, 20, 0.95),   # both filters (bounded)
    (2.0, 5, 0.8),     # hot + tight filters (bounded)
])
def test_constrained_samples_always_parse(weights, temperature, top_k, top_p):
    eng = _port_engine(weights[1])
    prompt = _prompts()["a"]
    results = eng.generate(
        [prompt, prompt],
        tengine.SamplingParams(max_tokens=1, temperature=temperature,
                               top_k=top_k, top_p=top_p, constrained=True))
    for res in results:
        assert res.finish_reason == "eos", res
        verdict = parse_verdict(TOK.decode(res.token_ids))
        assert verdict["severity"] in ("info", "warning", "critical")
        assert verdict["root_cause"]
    assert (eng.bounded_decode_steps > 0) == (top_k > 0 and temperature > 0)


def test_constrained_submit_requires_grammar(weights):
    eng = _port_engine(weights[1], grammar=False)
    with pytest.raises(ValueError, match="set_grammar"):
        eng.submit(tengine.GenerationRequest(
            "x", TOK.encode("x"),
            tengine.SamplingParams(max_tokens=1, constrained=True)))


def test_submit_raises_max_tokens_then_caps(weights):
    """max_tokens is raised to the grammar's max_len (469), then cut to the
    table's capacity, in the JAX engine's order: a verdict that cannot fit
    ends "length" on both engines."""
    small = dict(ECFG_KW, max_blocks_per_seq=8)       # 128 tokens
    fsm = verdict_fsm(eos_id=TOK.eos_id)
    prompt = _prompts()["a"]
    port = tengine.InferenceEngine(ModelConfig(**CFG_KW), weights[1],
                                   tengine.EngineConfig(prefix_cache_entries=0,
                                                        **small),
                                   tokenizer=TOK, device="cpu")
    port.set_grammar(fsm)
    req = tengine.GenerationRequest(
        "v", list(prompt), tengine.SamplingParams(max_tokens=1,
                                                  constrained=True))
    port.submit(req)
    assert fsm.max_len == 469
    assert req.sampling.max_tokens == port.capacity_tokens - 1
    assert len(req.prompt_ids) + req.sampling.max_tokens == 128
    while port.has_work:
        port.step()
    jeng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), weights[0],
        jengine.EngineConfig(prefix_cache_entries=0, **small), tokenizer=TOK)
    jeng.set_grammar(jverdict_fsm(eos_id=TOK.eos_id))
    want = jeng.generate([prompt], jengine.SamplingParams(max_tokens=1,
                                                          constrained=True))
    got = port.poll("v")
    assert got.finish_reason == want[0].finish_reason == "length"
    assert got.token_ids == want[0].token_ids
