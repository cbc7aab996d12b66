"""The port's LocalEngineBackend: EngineService over the port's engine
with the verdict grammar installed.

On the same float32 weights, a greedy constrained verdict through the
port's backend equals the JAX package's ``LocalEngineBackend`` verdict and
parses; ``generate_stream``'s chunks concatenate to ``generate``'s text
under greedy; ``generate_with_grammar`` decodes under another grammar and
restores the verdict grammar; a shed surfaces as ``OverloadedError`` with
the request's class; the supervised (``engine_factory=``) mode gives the
pinned engine's greedy text.
"""

import jax
import numpy as np
import pytest

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.monitor.analysis import (
    LocalEngineBackend as JLocalEngineBackend,
)
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.diagnosis.grammar import (
    compile_schema,
    parse_verdict,
    parse_with_dfa,
    token_fsm,
    verdict_fsm,
)
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.monitor.analysis import (
    LLMBackend,
    LocalEngineBackend,
    OverloadedError,
    TemplateBackend,
)
from k8s_llm_monitor_tpu_torch.serving.engine import (
    EngineConfig,
    InferenceEngine,
)
from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=1e4)
ECFG_KW = dict(max_slots=4, num_blocks=256, block_size=16,
               max_blocks_per_seq=64, prefill_buckets=(64,),
               decode_steps_per_iter=8)
QUESTION = "## Question\nwhy is default/web crashlooping?\n"
OK_SCHEMA = {"type": "object", "properties": {"ok": {"enum": ["yes", "no"]}},
             "required": ["ok"]}


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_jax(tree, ModelConfig(**CFG_KW), device="cpu")


@pytest.fixture
def backend(weights):
    # The prefix cache off, as in the JAX engine the tests compare with.
    eng = InferenceEngine(ModelConfig(**CFG_KW), weights[1],
                          EngineConfig(prefix_cache_entries=0, **ECFG_KW),
                          tokenizer=ByteTokenizer(), device="cpu")
    b = LocalEngineBackend(engine=eng, tokenizer=ByteTokenizer())
    yield b
    b.service.stop()


def test_generate_constrained_parses_and_equals_jax(weights, backend):
    assert backend.supports_grammar
    got = backend.generate_constrained(QUESTION)
    parse_verdict(got)
    jeng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), weights[0],
        jengine.EngineConfig(prefix_cache_entries=0, **ECFG_KW),
        tokenizer=JByteTokenizer())
    jb = JLocalEngineBackend(engine=jeng, tokenizer=JByteTokenizer())
    try:
        want = jb.generate_constrained(QUESTION)
    finally:
        jb.service.stop()
    assert got == want
    # One constrained and one free sample: the overhead gauge is defined.
    backend.generate("free text", max_tokens=16, temperature=0.0)
    assert backend.constrained_decode_overhead_ms >= 0.0


def test_stream_concatenates_to_generate(backend):
    text = backend.generate(QUESTION, max_tokens=24, temperature=0.0)
    chunks = list(backend.generate_stream(QUESTION, max_tokens=24,
                                          temperature=0.0))
    assert len(chunks) >= 1 and "".join(chunks) == text


def test_sampled_generate_takes_the_bounded_sampler(backend):
    outs = [backend.generate(QUESTION, max_tokens=16, temperature=0.7,
                             top_k=40) for _ in range(2)]
    assert all(isinstance(o, str) for o in outs)
    assert backend.engine.bounded_decode_steps > 0


def test_generate_with_grammar_restores_verdict_grammar(backend):
    verdict = verdict_fsm(eos_id=2)
    assert backend.engine._grammar is verdict
    ok_dfa = compile_schema(OK_SCHEMA)
    text = backend.generate_with_grammar(QUESTION, token_fsm(ok_dfa, eos_id=2))
    assert parse_with_dfa(text, ok_dfa)["ok"] in ("yes", "no")
    assert backend.engine._grammar is verdict
    parse_verdict(backend.generate_constrained(QUESTION))


def test_shed_surfaces_as_overloaded_with_class(backend):
    eng = backend.engine
    real = eng.should_shed
    eng.should_shed = lambda slo_class="standard", need_tokens=0: "forced"
    try:
        with pytest.raises(OverloadedError) as ei:
            backend.generate(QUESTION, max_tokens=4, slo_class="batch")
        assert ei.value.slo_class == "batch"
        with pytest.raises(OverloadedError) as ei:
            backend.generate_constrained(QUESTION, slo_class="interactive")
        assert ei.value.slo_class == "interactive"
    finally:
        eng.should_shed = real
    assert backend.service.shed_count_by_class == {"batch": 1,
                                                   "interactive": 1}


def test_supervised_mode_and_other_backends(weights, backend):
    # engine_factory= puts an EngineSupervisor under the backend: the same
    # greedy text as the pinned engine's backend; a factory that does not
    # install the verdict grammar leaves the render path for verdicts.
    with pytest.raises(ValueError, match="engine_factory"):
        LocalEngineBackend()
    sup_backend = LocalEngineBackend(
        engine_factory=lambda: InferenceEngine(
            ModelConfig(**CFG_KW), weights[1], EngineConfig(**ECFG_KW),
            tokenizer=ByteTokenizer(), device="cpu"),
        tokenizer=ByteTokenizer())
    try:
        assert sup_backend.supervisor is not None
        assert sup_backend.service is sup_backend.supervisor.service
        assert not sup_backend.supports_grammar
        assert sup_backend.generate(QUESTION, max_tokens=8,
                                    temperature=0.0) == \
            backend.generate(QUESTION, max_tokens=8, temperature=0.0)
        parse_verdict(sup_backend.generate_constrained(QUESTION))
    finally:
        sup_backend.supervisor.shutdown(grace_s=1.0)
    # Without the byte tokenizer no grammar is installed and the verdict
    # comes from the render path; the template backend renders directly.
    eng = InferenceEngine(ModelConfig(**CFG_KW), weights[1],
                          EngineConfig(**ECFG_KW), tokenizer=ByteTokenizer(),
                          device="cpu")
    assert not LocalEngineBackend._install_verdict_grammar(eng, object())
    assert eng._grammar is None
    parse_verdict(TemplateBackend().generate_constrained(
        '- pod "web-1" CrashLoopBackOff\n'))
    with pytest.raises(NotImplementedError):
        LLMBackend().generate("x")
