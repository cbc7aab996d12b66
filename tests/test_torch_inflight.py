"""Dispatch-ahead decode in the port's engine against the JAX engine.

Same float32 weights (params_from_jax); the JAX engine runs at its default
``max_inflight`` 2, the port at 0 to 3.  On the CPU a decode call is done
when it returns, so ``step()``'s drain of finished calls reconciles it at
once; the "slow" cases make every call report not ready (as a busy device
would), so only the ``max_inflight`` window reconciles and calls stay in
flight across steps: lanes retire at EOS with later steps of theirs still
in flight (zombie steps), slots are reused, pages wait for the calls that
may write them.  Greedy ids are compared exactly, free and constrained
under the verdict grammar; the free lanes mix lengths, a chunked prompt
and EOS retirement.  Also: the allocator back at its idle count after a
run, a retired lane's blocks held while a call in flight references it, a
lane cancelled with calls in flight, the decode schedule while a prompt
streams in chunks (``decode_every_n_chunk_rounds``), the addresses the
captured decode graphs read staying fixed across calls and grammar swaps,
the kinds of the calls in flight (admission, chunk, decode) after every
step against the JAX engine's at ``max_inflight`` 0-3, the flash bucket
ladder (4096/8192), the synchronous admission loop (``admit_inflight``)
and first tokens delivered before their call's reconcile on the card.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.diagnosis.grammar import compile_schema as jcompile
from k8s_llm_monitor_tpu.diagnosis.grammar import token_fsm as jtoken_fsm
from k8s_llm_monitor_tpu.diagnosis.grammar import verdict_fsm as jverdict_fsm
from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.diagnosis.grammar import (
    compile_schema,
    parse_verdict,
    parse_with_dfa,
    token_fsm,
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
# Two slots for five requests (slots are reused), one 16-token bucket (the
# 40-token prompt is chunked), four steps per decode call.
FREE_ECFG = dict(max_slots=2, num_blocks=64, block_size=8,
                 max_blocks_per_seq=16, prefill_buckets=(16,),
                 decode_steps_per_iter=4)
# The constrained file's engine: 1024 tokens per sequence fit a verdict.
GRAMMAR_ECFG = dict(max_slots=2, num_blocks=256, block_size=16,
                    max_blocks_per_seq=64, prefill_buckets=(32,),
                    decode_steps_per_iter=8)
MAX_TOKENS = 12
TOK = ByteTokenizer()
# A grammar with fewer states than the verdict's, over the same vocab.
SMALL_SCHEMA = {"type": "object",
                "properties": {"ok": {"enum": ["yes", "no"]}},
                "required": ["ok"]}


def _free_prompts():
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(3, 300, size=n)]
            for n in (4, 11, 40, 16, 9)]


def _grammar_reqs():
    rng = np.random.default_rng(7)
    return [("b", [int(t) for t in rng.integers(3, 259, size=11)], False),
            ("a", TOK.encode("## Question\nwhy is default/web crashlooping?\n"),
             True)]


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_jax(tree, ModelConfig(**CFG_KW), device="cpu")


@pytest.fixture
def slow(monkeypatch):
    """Every decode call reports not ready: only the window reconciles."""
    monkeypatch.setattr(tengine.InferenceEngine, "_call_ready",
                        staticmethod(lambda call: False))


def _port(model, ecfg, eos_id=-1, **overrides):
    """The port's engine; the prefix cache off, as in the JAX engines these
    tests compare with."""
    return tengine.InferenceEngine(
        ModelConfig(**CFG_KW), model,
        tengine.EngineConfig(**dict(dict(ecfg, prefix_cache_entries=0),
                                    **overrides)),
        tokenizer=TOK, eos_id=eos_id, device="cpu")


def _run(mod, eng, reqs, on_step=None):
    """Submit ``reqs`` ((id, prompt, constrained) triples, greedy) together
    and step the engine to completion; results by id."""
    for rid, prompt, constrained in reqs:
        eng.submit(mod.GenerationRequest(rid, list(prompt), mod.SamplingParams(
            max_tokens=1 if constrained else MAX_TOKENS,
            constrained=constrained)))
    while eng.has_work:
        eng.step()
        if on_step is not None:
            on_step(eng)
    return {rid: eng.poll(rid) for rid, _, _ in reqs}


def _ids(results):
    return {rid: (r.token_ids, r.finish_reason) for rid, r in results.items()}


def _free_reqs():
    return [(f"p{i}", p, False) for i, p in enumerate(_free_prompts())]


@pytest.fixture(scope="module")
def free_eos(weights):
    """An EOS id the first prompt emits first as its fifth token or later:
    that lane retires inside a decode call."""
    ids = _run(tengine, _port(weights[1], FREE_ECFG), _free_reqs())[
        "p0"].token_ids
    return next(t for i, t in enumerate(ids) if i >= 4 and t not in ids[:i])


@pytest.fixture(scope="module")
def jax_free(weights, free_eos):
    eng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), weights[0],
        jengine.EngineConfig(prefix_cache_entries=0, **FREE_ECFG),
        eos_id=free_eos)
    assert eng.ecfg.max_inflight == 2
    return _ids(_run(jengine, eng, _free_reqs()))


@pytest.fixture(scope="module")
def jax_grammar(weights):
    eng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), weights[0],
        jengine.EngineConfig(prefix_cache_entries=0, **GRAMMAR_ECFG),
        tokenizer=TOK)
    eng.set_grammar(jverdict_fsm(eos_id=TOK.eos_id))
    return _ids(_run(jengine, eng, _grammar_reqs()))


def _assert_idle(eng):
    """Nothing in flight, no deferred frees, every block but the null one
    back on the free list."""
    assert not eng._inflight and not eng._deferred_frees
    assert eng.allocator.free_blocks == eng.ecfg.num_blocks - 1


@pytest.mark.parametrize("mode", ["drain", "slow"])
@pytest.mark.parametrize("max_inflight", [0, 1, 2, 3])
def test_free_greedy_ids_match_jax_engine(request, weights, free_eos,
                                          jax_free, max_inflight, mode):
    if mode == "slow":
        request.getfixturevalue("slow")
    eng = _port(weights[1], FREE_ECFG, eos_id=free_eos,
                max_inflight=max_inflight)
    assert eng.allocator.free_blocks == FREE_ECFG["num_blocks"] - 1
    got = _ids(_run(tengine, eng, _free_reqs()))
    assert got == jax_free
    assert got["p0"][1] == "eos" and len(got["p0"][0]) >= 4
    _assert_idle(eng)


@pytest.mark.parametrize("mode,max_inflight", [
    ("drain", 2), ("slow", 1), ("slow", 2), ("slow", 3)])
def test_constrained_greedy_ids_match_jax_engine(request, weights,
                                                 jax_grammar, max_inflight,
                                                 mode):
    if mode == "slow":
        request.getfixturevalue("slow")
    eng = _port(weights[1], GRAMMAR_ECFG, eos_id=TOK.eos_id,
                max_inflight=max_inflight)
    eng.set_grammar(verdict_fsm(eos_id=TOK.eos_id))
    got = _ids(_run(tengine, eng, _grammar_reqs()))
    assert got == jax_grammar
    assert got["a"][1] == "eos"
    parse_verdict(TOK.decode(got["a"][0]))
    _assert_idle(eng)


def test_retired_lane_blocks_wait_for_calls_in_flight(slow, weights,
                                                      free_eos):
    eng = _port(weights[1], FREE_ECFG, eos_id=free_eos, max_inflight=2)
    held = []

    def check(e):
        live = {b for s in e._slots if s is not None for b in s.blocks}
        for call in e._inflight:
            if call.kind != "decode":
                continue
            for slot_idx, s, _ in call.lanes:
                if e._slots[slot_idx] is not s:       # retired, in flight
                    held.append(s.req.request_id)
                    # Still allocated (a free empties the list), and to no
                    # one else.
                    assert s.blocks and all(
                        e.allocator.ref_count(b) == 1 for b in s.blocks)
                    assert not live & set(s.blocks)

    _run(tengine, eng, _free_reqs(), on_step=check)
    assert "p0" in held             # p0 hit EOS with zombie steps in flight
    _assert_idle(eng)


def test_cancel_with_calls_in_flight(slow, weights):
    prompt = _free_prompts()[1]
    sp = tengine.SamplingParams(max_tokens=40)
    [want] = _port(weights[1], FREE_ECFG).generate([prompt], sp)
    eng = _port(weights[1], FREE_ECFG, max_inflight=2)
    calls = []
    eng.token_sink = lambda rid, toks, res: calls.append((list(toks), res))
    eng.submit(tengine.GenerationRequest("r", list(prompt), sp))
    # Two decode calls in flight, the first token's call reconciled (its
    # reconcile retires a cancelled lane at once, as in the JAX engine).
    while len(eng._inflight) < 2 or any(c.kind != "decode"
                                        for c in eng._inflight):
        eng.step()
    [slot] = [s for s in eng._slots if s is not None]
    expect = len(slot.generated) + slot.inflight_decode
    assert eng.cancel("r")
    while eng.has_work:
        eng.step()
    results = [res for _, res in calls if res is not None]
    assert len(results) == 1 and calls[-1][1] is results[0]
    streamed = [t for toks, _ in calls for t in toks]
    assert results[0].token_ids == streamed == want.token_ids[:expect]
    assert expect == 9             # the first token and two calls of four
    assert eng.poll("r") is results[0]
    _assert_idle(eng)


def _decode_schedule(mod, eng, reqs, n_steps):
    """The decode-step count after each of ``n_steps`` steps."""
    for rid, prompt, max_tokens in reqs:
        eng.submit(mod.GenerationRequest(rid, list(prompt), mod.SamplingParams(
            max_tokens=max_tokens)))
    out = []
    for _ in range(n_steps):
        eng.step()
        out.append(eng.steps)
    assert not eng.has_work
    return out


@pytest.mark.parametrize("every", [1, 3])
def test_decode_every_n_chunk_rounds_matches_jax_engine(weights, every):
    # A decoding lane beside a 100-token prompt that streams in seven
    # 16-token chunk rounds: while chunks are pending, a decode call goes
    # out only every ``every``-th step.
    rng = np.random.default_rng(11)
    reqs = [("short", [int(t) for t in rng.integers(3, 300, size=4)], 20),
            ("long", [int(t) for t in rng.integers(3, 300, size=100)], 8)]
    ecfg = dict(FREE_ECFG, decode_every_n_chunk_rounds=every)
    want = _decode_schedule(jengine, jengine.InferenceEngine(
        JModelConfig(**CFG_KW), weights[0],
        jengine.EngineConfig(prefix_cache_entries=0, **ecfg), eos_id=-1),
        reqs, 16)
    got = _decode_schedule(tengine, _port(weights[1], ecfg), reqs, 16)
    assert got == want
    # The gate held decode back while the chunks streamed in.
    assert (want[1] == 0) == (every == 3)


def test_static_buffers_keep_their_address(weights):
    small = token_fsm(compile_schema(SMALL_SCHEMA), eos_id=TOK.eos_id)
    verdict = verdict_fsm(eos_id=TOK.eos_id)
    assert small.trans.shape[0] < verdict.trans.shape[0]
    eng = _port(weights[1], GRAMMAR_ECFG, eos_id=TOK.eos_id)
    eng.set_grammar(verdict)
    names = ("_tok_state", "_fsm_state", "_fsm_trans", "_fsm_pad", "_dec_in")
    ptrs = {n: getattr(eng, n).data_ptr() for n in names}
    q = TOK.encode("is the api up?")
    reqs = [("free", q, False), ("c", q, True)]
    eng.set_grammar(small)
    first = _ids(_run(tengine, eng, reqs))
    programs = dict(eng._programs)
    eng.set_grammar(verdict)
    eng.set_grammar(small)
    again = _ids(_run(tengine, eng, reqs))
    assert {n: getattr(eng, n).data_ptr() for n in names} == ptrs
    assert eng._programs == programs            # no program was rebuilt
    # The smaller grammar in the taller table decodes as it does alone.
    fresh = _port(weights[1], GRAMMAR_ECFG, eos_id=TOK.eos_id)
    fresh.set_grammar(small)
    assert first == again == _ids(_run(tengine, fresh, reqs))
    assert parse_with_dfa(TOK.decode(first["c"][0]),
                          compile_schema(SMALL_SCHEMA))["ok"] in ("yes", "no")
    # A wider grammar table takes a new buffer and drops the constrained
    # programs that read the old one.
    wide = token_fsm(compile_schema(SMALL_SCHEMA), eos_id=TOK.eos_id,
                     vocab_size=280)
    _run(tengine, eng, [("free-only", q, False)])
    eng.set_grammar(wide)
    assert eng._fsm_trans.shape[1] == 280
    assert not any(p.constrained for p in eng._programs.values())
    assert any(not p.constrained for p in eng._programs.values())


def _kinds_run(mod, eng, reqs):
    """Greedy ids by request and, after each step, the kinds of the calls
    left in flight."""
    for rid, prompt, constrained in reqs:
        eng.submit(mod.GenerationRequest(rid, list(prompt), mod.SamplingParams(
            max_tokens=1 if constrained else MAX_TOKENS,
            constrained=constrained)))
    kinds = []
    while eng.has_work:
        eng.step()
        kinds.append(tuple(c.kind for c in eng._inflight))
    return kinds, _ids({rid: eng.poll(rid) for rid, _, _ in reqs})


@pytest.fixture(scope="module")
def jax_kinds_engine(weights):
    """The JAX engine of the call-kinds test, under the small grammar (a
    verdict would decode 469 steps per case)."""
    eng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), weights[0],
        jengine.EngineConfig(prefix_cache_entries=0, **GRAMMAR_ECFG),
        tokenizer=TOK)
    eng.set_grammar(jtoken_fsm(jcompile(SMALL_SCHEMA), eos_id=TOK.eos_id))
    return eng


@pytest.mark.parametrize("max_inflight", [0, 1, 2, 3])
def test_inflight_call_kinds_match_jax_engine(slow, monkeypatch, weights,
                                              jax_kinds_engine, max_inflight):
    # Admission, chunk and decode calls stay in flight as in the JAX engine:
    # a constrained question and a free prompt longer than the 32-token
    # bucket (both chunked) beside a short free one, every call reporting
    # not ready on both engines, so only the window reconciles.
    monkeypatch.setattr(jengine.InferenceEngine, "_call_ready",
                        staticmethod(lambda call: False))
    rng = np.random.default_rng(5)
    reqs = [("long", [int(t) for t in rng.integers(3, 259, size=70)], False),
            *_grammar_reqs()]
    jeng = jax_kinds_engine
    jeng.ecfg = dataclasses.replace(jeng.ecfg, max_inflight=max_inflight)
    want = _kinds_run(jengine, jeng, reqs)
    eng = _port(weights[1], GRAMMAR_ECFG, eos_id=TOK.eos_id,
                max_inflight=max_inflight)
    eng.set_grammar(token_fsm(compile_schema(SMALL_SCHEMA), eos_id=TOK.eos_id))
    got = _kinds_run(tengine, eng, reqs)
    assert got == want
    # At depth 1 the admission call is reconciled in its own step: the
    # step's decode call goes out behind it.
    kinds = {k for step in got[0] for k in step}
    assert kinds == ({"chunk", "decode"} | ({"admit"} if max_inflight > 1
                                            else set())
                     if max_inflight else set())
    _assert_idle(eng)


def test_flash_bucket_ladder_matches_jax_engine(weights):
    # With the flash prefill path the ladder gains 4096 and 8192 where the
    # per-sequence capacity allows, as in the JAX engine.
    for nbps, num_blocks, extra in ((64, 512, ()), (256, 512, (4096,)),
                                    (512, 600, (4096, 8192))):
        ecfg = dict(max_slots=2, num_blocks=num_blocks, block_size=16,
                    max_blocks_per_seq=nbps, prefill_path="flash")
        jeng = jengine.InferenceEngine(
            JModelConfig(**CFG_KW), weights[0],
            jengine.EngineConfig(prefix_cache_entries=0, **ecfg))
        eng = _port(weights[1], ecfg)
        assert eng.ecfg.prefill_buckets == jeng.ecfg.prefill_buckets
        assert eng.ecfg.prefill_buckets == (
            tengine.EngineConfig().prefill_buckets + extra)
        dense = _port(weights[1], dict(ecfg, prefill_path="dense"))
        assert dense.ecfg.prefill_buckets[-1] == 2048


def test_synchronous_admission_matches_jax_engine(weights, free_eos,
                                                  jax_free):
    # admit_inflight False: each admission and chunk round's first tokens
    # are read back in its own round (the loop before they went in
    # flight); no such call outlives its round, and the ids are the same.
    eng = _port(weights[1], FREE_ECFG, eos_id=free_eos, admit_inflight=False)
    left = []
    got = _ids(_run(tengine, eng, _free_reqs(), on_step=lambda e: left.extend(
        c.kind for c in e._inflight if c.kind != "decode")))
    assert got == jax_free and not left
    _assert_idle(eng)


class _Done:
    """Stands in for a CUDA event the device has passed."""

    def query(self):
        return True

    def synchronize(self):
        pass


@pytest.fixture
def finished_events(monkeypatch):
    """Every admission and chunk call carries a passed event, as on the
    card once the device has run it."""
    queue = tengine.InferenceEngine._queue_inflight

    def patched(self, *args, **kwargs):
        queue(self, *args, **kwargs)
        self._inflight[-1].event = _Done()

    monkeypatch.setattr(tengine.InferenceEngine, "_queue_inflight", patched)


def test_finished_first_tokens_go_out_before_their_reconcile(
        slow, finished_events, weights, free_eos, jax_free):
    # On the card a finished admission or chunk call delivers its first
    # tokens ahead of its reconcile: each token once and in order, the
    # JAX engine's ids, slots handed over at the reconcile as without it.
    eng = _port(weights[1], FREE_ECFG, eos_id=free_eos, max_inflight=2)
    streamed, early = {}, []

    def sink(rid, toks, res):
        streamed.setdefault(rid, []).extend(toks)
        if toks and any(c.delivered for c in eng._inflight):
            early.append(rid)

    eng.token_sink = sink
    got = _ids(_run(tengine, eng, _free_reqs()))
    assert got == jax_free
    assert set(early) == set(got)
    for rid, (ids, reason) in got.items():
        assert streamed[rid] == ids + ([free_eos] if reason == "eos" else [])
    _assert_idle(eng)
