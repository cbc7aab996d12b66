"""Speculative decoding in the port (serving/spec.py, llama.verify_step and
the engine's spec path) against the JAX package on the CPU.

  * ``propose_drafts`` and ``accept_greedy`` give the JAX functions' outputs
    on the same seeded inputs (n-gram matches, EOS truncation, the quota,
    inactive lanes, -1 padding never matching an eos of -1), and
    ``AcceptanceEMA`` the same snapshots and draft decisions over one
    update sequence: exact.
  * ``accept_sampled`` draws from a ``torch.Generator``, whose bits differ
    from ``jax.random``'s: its first emitted token's marginal must equal
    the target distribution (plain and top-k filtered; Monte Carlo over
    4,000 lanes, atol 4 / sqrt(N)), and greedy lanes take the argmax.
  * ``verify_step`` on the same float32 weights equals the JAX package's
    (atol = rtol = 2e-4: float32 through two layers, sums in another order)
    and the port's own sequential ``decode_step`` logits, over a float32 pool
    and over an int8 pool (the gather/dequant branch and the flash wrapper's
    plain version).
  * The spec engine (float32 weights, greedy): the ids equal the JAX spec
    engine's and the port's spec-off run, and ``spec_tokens``,
    ``spec_verify_steps``, ``spec_lane_rounds`` and ``spec_accept_ema()``
    equal the JAX engine's, in the JAX package's scenarios (a repetitive
    prompt, EOS, chunked admission, page pressure, the capacity boundary,
    adapting off at low acceptance); mixed greedy and sampled lanes, a
    sampled admission while a spec call is in flight, constrained lanes and
    brownout, which take no drafts; ``from_config`` with the default
    ``spec_k``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.serving import spec as jspec
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.serving import spec as tspec


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
TCFG = ModelConfig(**CFG_KW)
JCFG = JModelConfig(**CFG_KW)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    model = params_from_jax(jax.tree.map(np.asarray, params), TCFG,
                            device="cpu")
    return params, model


# ---------------------------------------------------------------------------
# proposer, acceptance, EMA
# ---------------------------------------------------------------------------


def _hist_case(seed, B=8, H=48):
    """History rows that repeat short patterns (so 2- and 3-gram matches
    exist), -1 padding past each lane's context, ctx at 0, 1, 2 and deep."""
    rng = np.random.default_rng(seed)
    hist = np.full((B, H), -1, np.int32)
    ctx = np.asarray([0, 1, 2, 5, 17, 30, H - 2, H - 1][:B], np.int32)
    for b in range(B):
        pat = rng.integers(3, 9, size=rng.integers(2, 6))
        row = np.resize(pat, ctx[b] + 1)
        row[rng.random(ctx[b] + 1) < 0.15] = rng.integers(3, 9)
        hist[b, :ctx[b] + 1] = row
    return hist, ctx, hist[np.arange(B), ctx]


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 4), (2, 7), (3, 1)])
def test_propose_drafts_matches_jax(seed, k):
    hist, ctx, cur = _hist_case(seed)
    want = np.asarray(jspec.propose_drafts(jnp.asarray(hist), jnp.asarray(ctx),
                                           jnp.asarray(cur), k))
    got = tspec.propose_drafts(torch.from_numpy(hist), torch.from_numpy(ctx),
                               torch.from_numpy(cur), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all()          # -1 padding comes back as token 0


GREEDY_CASES = [
    # full accept + bonus; mismatch at draft 1; mismatch at draft 0
    ([[10, 11, 12, 13], [10, 99, 12, 13], [77, 11, 12, 13]],
     [[10, 11, 12]] * 3, [64, 64, 64], [True] * 3, -1),
    # EOS inside the accepted run truncates after it
    ([[10, 5, 12, 13]], [[10, 5, 12]], [64], [True], 5),
    # the quota, and an inactive lane
    ([[10, 11, 12, 13], [10, 11, 12, 13]], [[10, 11, 12]] * 2, [2, 64],
     [True, False], -1),
    # eos -1 never matches the -1 padding
    ([[10, 11, 12, 13]], [[99, 11, 12]], [64], [True], -1),
]


def _random_greedy_case(seed, B=16, K=4):
    rng = np.random.default_rng(seed)
    greedy = rng.integers(0, 6, size=(B, K + 1)).astype(np.int32)
    drafts = np.where(rng.random((B, K)) < 0.7, greedy[:, :K],
                      rng.integers(0, 6, size=(B, K))).astype(np.int32)
    quota = rng.integers(0, K + 3, size=B).astype(np.int32)
    return greedy, drafts, quota, rng.random(B) < 0.8, 3


@pytest.mark.parametrize("case", GREEDY_CASES + [_random_greedy_case(s)
                                                 for s in range(3)])
def test_accept_greedy_matches_jax(case):
    greedy, drafts, quota, active, eos = (np.asarray(x) for x in case)
    greedy, drafts, quota = (x.astype(np.int32) for x in (greedy, drafts,
                                                          quota))
    active = active.astype(bool)
    jemit, jout = jspec.accept_greedy(
        jnp.asarray(greedy), jnp.asarray(drafts), jnp.asarray(quota),
        jnp.asarray(active), jnp.asarray(int(eos), jnp.int32))
    temit, tout = tspec.accept_greedy(
        torch.from_numpy(greedy), torch.from_numpy(drafts),
        torch.from_numpy(quota), torch.from_numpy(active), int(eos))
    np.testing.assert_array_equal(temit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_acceptance_ema_matches_jax():
    rng = np.random.default_rng(5)
    j = jspec.AcceptanceEMA(floor=1.2, probe_every=4)
    t = tspec.AcceptanceEMA(floor=1.2, probe_every=4)
    for i in range(60):
        klass = ("greedy", "sampled")[i % 3 == 0]
        if i % 2:
            n = int(rng.integers(0, 5))
            acc = int(rng.integers(n, 3 * n + 1)) if n else 0
            j.update(klass, acc, n)
            t.update(klass, acc, n)
        assert t.should_draft(klass) == j.should_draft(klass)
        assert t.snapshot() == j.snapshot()
        assert t.drafting_disabled(klass) == j.drafting_disabled(klass)


def _marginal(top_k=None):
    V, temp, N = 6, 0.7, 4000
    row = np.array([2.0, 0.5, 1.0, -1.0, 0.0, 1.5], np.float32)
    scaled = row / temp
    if top_k:
        keep = np.argsort(-scaled)[:top_k]
        p = np.zeros(V)
        ex = np.exp(scaled[keep] - scaled[keep].max())
        p[keep] = ex / ex.sum()
        draft0 = int(keep[1])
    else:
        p = np.exp(scaled) / np.exp(scaled).sum()
        draft0 = 2
    logits = torch.from_numpy(np.tile(row, (N, 3, 1)))        # [N, K+1, V]
    drafts = torch.tensor([[draft0, 1]] * N, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    kw = {}
    if top_k:
        kw = dict(top_k=torch.full((N,), top_k, dtype=torch.int32),
                  top_p=torch.ones(N))
    _, out = tspec.accept_sampled(
        gen, logits, drafts, torch.full((N,), 64, dtype=torch.int32),
        torch.ones(N, dtype=torch.bool), -1, torch.full((N,), temp), **kw)
    freq = np.bincount(out[:, 0].numpy(), minlength=V) / N
    return freq, p, N


@pytest.mark.parametrize("top_k", [None, 2])
def test_accept_sampled_marginal_is_the_target(top_k):
    """Accept draft x with probability p(x), else resample from p with x
    zeroed: the first emitted token is distributed as p, plain or top-k
    filtered (nothing outside the filter is ever emitted)."""
    freq, p, N = _marginal(top_k)
    np.testing.assert_allclose(freq, p, atol=4.0 / np.sqrt(N))
    assert freq[p == 0].sum() == 0.0


def test_accept_sampled_greedy_lanes_take_the_argmax():
    V = 5
    logits = np.zeros((2, 3, V), np.float32)
    logits[:, 0, 3] = 9.0
    logits[:, 1, 4] = 9.0
    logits[:, 2, 1] = 9.0
    emit, out = tspec.accept_sampled(
        torch.Generator().manual_seed(0), torch.from_numpy(logits),
        torch.tensor([[3, 4], [0, 0]], dtype=torch.int32),
        torch.tensor([64, 64], dtype=torch.int32),
        torch.tensor([True, True]), -1, torch.zeros(2))
    assert emit.tolist() == [3, 1]
    assert out.tolist() == [[3, 4, 1], [3, -1, -1]]


# ---------------------------------------------------------------------------
# verify_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["", "int8"])
def test_verify_step_matches_jax_and_sequential_decode(weights, kv):
    params, model = weights
    nb, bs, W = 32, 8, 8
    rng = np.random.default_rng(1)
    prompt = [int(t) for t in rng.integers(3, 300, size=9)]
    fed = [int(t) for t in rng.integers(3, 300, size=5)]   # a draft chain
    tables = np.zeros((1, W), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    toks = np.zeros((1, 16), np.int32)
    toks[0, :9] = prompt

    jp = jllama.init_kv_pages(JCFG, nb, bs, kv_quant=kv)
    _, jp = jllama.prefill(params, JCFG, jnp.asarray(toks),
                           jnp.asarray([9], jnp.int32), jp,
                           jnp.asarray(tables))
    jlog, _ = jllama.verify_step(
        params, JCFG, jnp.asarray([fed], jnp.int32),
        jnp.asarray([9], jnp.int32), jnp.asarray([5], jnp.int32), jp,
        jnp.asarray(tables))

    def port_pages():
        pages = tllama.init_kv_pages(TCFG, nb, bs, "cpu", kv_quant=kv)
        tllama.prefill(model, torch.from_numpy(toks),
                       torch.tensor([9], dtype=torch.int32), pages,
                       torch.from_numpy(tables))
        return pages

    ttab = torch.from_numpy(tables)
    impls = [None] + ([pa.flash_prefill_attention] if kv else
                      [tengine.select_verify_impl(torch.device("cpu"), TCFG)])
    for impl in impls:
        got, _ = tllama.verify_step(
            model, torch.tensor([fed], dtype=torch.int32),
            torch.tensor([9], dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32), port_pages(), ttab,
            attn_impl=impl)
        assert got.shape == (1, 5, TCFG.vocab_size)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jlog[0]),
                                   **LOGIT_TOL)
    pages = port_pages()
    for i, t in enumerate(fed):
        seq, _ = tllama.decode_step(
            model, torch.tensor([t], dtype=torch.int32),
            torch.tensor([9 + i], dtype=torch.int32), pages, ttab,
            attn_impl=tengine.paged_decode_attention)
        np.testing.assert_allclose(got[0, i].numpy(), seq[0].numpy(),
                                   **LOGIT_TOL)


# ---------------------------------------------------------------------------
# The spec engine
# ---------------------------------------------------------------------------

BASE = dict(max_slots=4, num_blocks=64, block_size=8, max_blocks_per_seq=16,
            prefill_buckets=(16, 32))


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, 300, size=n)] for n in sizes]


def _run_jax(params, prompts, ecfg, eos=-1, max_tokens=12):
    eng = jengine.InferenceEngine(JCFG, params, jengine.EngineConfig(**ecfg),
                                  eos_id=eos)
    res = eng.generate(prompts, jengine.SamplingParams(max_tokens=max_tokens))
    return eng, res


def _run_port(model, prompts, ecfg, eos=-1, max_tokens=12, brownout=None):
    eng = tengine.InferenceEngine(TCFG, model, tengine.EngineConfig(**ecfg),
                                  eos_id=eos, device="cpu")
    eng.brownout = brownout
    res = eng.generate(prompts, tengine.SamplingParams(max_tokens=max_tokens))
    return eng, res


def _counters(eng):
    return (eng.spec_tokens, eng.spec_verify_steps, eng.spec_lane_rounds,
            eng.spec_accept_ema())


# (name, engine overrides, prompt seed, prompt sizes, max_tokens, eos from
# the spec-off run's first request at this index or None)
SCENARIOS = [
    ("repetitive", dict(spec_rounds_per_iter=4), 7, (6, 6, 6), 48, None),
    ("eos", dict(spec_rounds_per_iter=2), 3, (7, 7, 7), 24, 12),
    ("chunked", dict(num_blocks=96, max_blocks_per_seq=24), 13, (75, 6), 10,
     None),
    ("pressure", dict(num_blocks=10, prefix_cache_entries=0), 11,
     (9, 9, 9, 9), 16, None),
    ("capacity", dict(max_blocks_per_seq=4, num_blocks=32,
                      prefill_buckets=(16,)), 23, (20,), 12, None),
    ("adapt_off", dict(spec_probe_every=6), 29, (6, 6, 6, 6), 60, None),
    ("always", dict(spec_min_accept=0.0, spec_rounds_per_iter=3), 31,
     (5, 11, 3, 8), 20, None),
]


@pytest.mark.parametrize("name,over,seed,sizes,max_tokens,eos_at",
                         SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_spec_engine_matches_jax(weights, monkeypatch, name, over, seed,
                                 sizes, max_tokens, eos_at):
    # The JAX engine's calls read as ready once dispatched (a CPU call of
    # the port's is done when it returns): both engines then reconcile in
    # the same steps, and schedule alike.
    monkeypatch.setattr(
        jengine.InferenceEngine, "_call_ready",
        staticmethod(lambda call: not isinstance(call.arr,
                                                 jengine._StuckPayload)))
    params, model = weights
    prompts = _prompts(seed, sizes)
    off = dict(BASE, **over)
    on = dict(off, spec_k=4)
    _, plain = _run_port(model, prompts, off, max_tokens=max_tokens)
    eos = -1
    if eos_at is not None:
        eos = plain[0].token_ids[eos_at]
        _, plain = _run_port(model, prompts, off, eos=eos,
                             max_tokens=max_tokens)
    jeng, jres = _run_jax(params, prompts, on, eos, max_tokens)
    teng, tres = _run_port(model, prompts, on, eos, max_tokens)
    ids = [r.token_ids for r in tres]
    assert ids == [r.token_ids for r in jres]
    assert ids == [r.token_ids for r in plain]
    assert ([r.finish_reason for r in tres]
            == [r.finish_reason for r in jres])
    assert _counters(teng) == _counters(jeng)
    assert teng.spec_verify_steps > 0
    assert teng.steps == jeng.steps
    if name == "repetitive":
        assert teng.spec_tokens > teng.spec_verify_steps   # multi-token rounds
    if name == "eos":
        assert any(r.finish_reason == "eos" for r in tres)
    if name == "pressure":
        assert teng.preemptions > 0
    if name == "adapt_off":
        assert teng.spec_verify_steps < teng.steps / 2
        assert set(teng.spec_accept_ema()) == {"greedy"}
        assert teng._spec_ema < 1.2


def test_spec_mixed_greedy_and_sampled_lanes(weights):
    """Greedy and sampled lanes share the sampled spec program; the greedy
    lanes keep the JAX spec engine's ids (argmax rule), the sampled ones
    complete with in-vocabulary tokens, nucleus and top-k lanes included."""
    params, model = weights
    prompts = _prompts(5, (6, 6, 6, 6))
    ec = dict(BASE, spec_k=4, spec_rounds_per_iter=2, spec_probe_every=1)
    sps = [dict(temperature=0.0), dict(temperature=0.8),
           dict(temperature=0.0), dict(temperature=0.8, top_p=0.9, top_k=5)]
    teng = tengine.InferenceEngine(TCFG, model, tengine.EngineConfig(**ec),
                                   eos_id=-1, device="cpu")
    jeng = jengine.InferenceEngine(JCFG, params, jengine.EngineConfig(**ec),
                                   eos_id=-1)
    for eng, mod in ((teng, tengine), (jeng, jengine)):
        for j, (p, sp) in enumerate(zip(prompts, sps)):
            eng.submit(mod.GenerationRequest(
                f"r{j}", p, mod.SamplingParams(max_tokens=10, **sp)))
        while eng.has_work:
            eng.step()
    tres = [teng.poll(f"r{j}") for j in range(4)]
    jres = [jeng.poll(f"r{j}") for j in range(4)]
    for j in (0, 2):
        assert tres[j].token_ids == jres[j].token_ids
    for r in tres:
        assert len(r.token_ids) == 10
        assert all(0 <= t < TCFG.vocab_size for t in r.token_ids)
    assert teng.spec_verify_steps > 0
    assert any(key[:1] == ("spec",) and key[3] and key[4]
               for key in teng._programs)      # the filtered variant ran


def test_spec_inflight_then_sampled_admission(weights, monkeypatch):
    """A sampled admission while a spec call is in flight: the next
    dispatch reconciles the spec call first, and the greedy lanes keep the
    spec-off ids."""
    _, model = weights
    gp = _prompts(17, (6, 6))
    ec = dict(BASE, spec_k=4, spec_rounds_per_iter=4, spec_min_accept=0.0)
    _, plain = _run_port(model, gp, dict(BASE), max_tokens=40)
    eng = tengine.InferenceEngine(TCFG, model, tengine.EngineConfig(**ec),
                                  eos_id=-1, device="cpu")
    for j, p in enumerate(gp):
        eng.submit(tengine.GenerationRequest(
            f"g{j}", p, tengine.SamplingParams(max_tokens=40)))
    monkeypatch.setattr(tengine.InferenceEngine, "_call_ready",
                        staticmethod(lambda call: False))
    for _ in range(50):
        eng.step()
        if any(c.kind == "spec" for c in eng._inflight):
            break
    assert any(c.kind == "spec" for c in eng._inflight)
    eng.submit(tengine.GenerationRequest(
        "s0", _prompts(18, (5,))[0],
        tengine.SamplingParams(max_tokens=8, temperature=0.9, top_p=0.9)))
    monkeypatch.undo()
    while eng.has_work:
        eng.step()
    for j in range(2):
        assert eng.poll(f"g{j}").token_ids == plain[j].token_ids
    assert len(eng.poll("s0").token_ids) == 8


def test_constrained_lanes_and_brownout_take_no_drafts(weights):
    """A constrained lane turns spec off for its call (the verify pass
    samples from unmasked logits), and so does brownout level 1; the ids
    stay the spec-off run's."""
    from k8s_llm_monitor_tpu_torch.diagnosis.grammar import TokenFSM

    _, model = weights
    prompts = _prompts(41, (6, 9))
    ec = dict(BASE, spec_k=4, spec_min_accept=0.0)
    _, plain = _run_port(model, prompts, dict(BASE), max_tokens=10)
    eng, res = _run_port(model, prompts, ec, max_tokens=10,
                         brownout=lambda: 1)
    assert [r.token_ids for r in res] == [r.token_ids for r in plain]
    assert eng.spec_verify_steps == 0
    # Every token allowed in state 1, which loops: a grammar that constrains
    # nothing, so the ids stay the free run's.
    trans = np.zeros((2, TCFG.vocab_size), np.int32)
    trans[1, :] = 1
    fsm = TokenFSM(trans=trans, start=1, accept=np.ones(2, bool), eos_id=-1,
                   max_len=0)
    eng = tengine.InferenceEngine(TCFG, model, tengine.EngineConfig(**ec),
                                  eos_id=-1, device="cpu")
    eng.set_grammar(fsm)
    for j, p in enumerate(prompts):
        eng.submit(tengine.GenerationRequest(
            f"c{j}", p, tengine.SamplingParams(max_tokens=10,
                                               constrained=j == 0)))
    while eng.has_work:
        eng.step()
    assert [eng.poll(f"c{j}").token_ids for j in range(2)] == [
        r.token_ids for r in plain]
    assert eng.spec_verify_steps == 0


def test_from_config_serves_the_default_spec_k(tmp_path):
    from k8s_llm_monitor_tpu_torch.monitor import analysis
    from k8s_llm_monitor_tpu_torch.monitor.config import (
        LifecycleConfig,
        TenancyConfig,
        TPULLMConfig,
    )

    tc = TPULLMConfig(model="tiny", quantize="", kv_blocks=64, max_batch=2,
                      spec_min_accept=0.5)
    assert tc.spec_k == 4
    backend = analysis.LocalEngineBackend.from_config(
        tc, lifecycle=LifecycleConfig(journal_dir=str(tmp_path)),
        tenancy=TenancyConfig(), device="cpu")
    try:
        eng = backend.engine
        assert eng.ecfg.spec_k == 4
        assert eng.ecfg.spec_min_accept == eng._spec_accept.floor == 0.5
        text = backend.generate("why crashloop? " * 4, max_tokens=12,
                                temperature=0.0)
        assert isinstance(text, str)
        assert eng.spec_verify_steps > 0
    finally:
        backend.supervisor.shutdown(grace_s=1.0)


def test_spec_hist_rows_written_at_admission(weights):
    """Each admitted prompt's head fills its lane's history row (-1 past
    it, the sink column included), as the JAX engine's ``_write_hist``."""
    _, model = weights
    ec = dict(BASE, spec_k=4, spec_hist_cap=32)
    eng = tengine.InferenceEngine(TCFG, model, tengine.EngineConfig(**ec),
                                  eos_id=-1, device="cpu")
    prompts = _prompts(3, (5, 40))
    for j, p in enumerate(prompts):
        eng.submit(tengine.GenerationRequest(
            f"h{j}", p, tengine.SamplingParams(max_tokens=8)))
    eng.step()
    assert eng._hist.shape == (4, 33)
    rows = {s.req.request_id: i for i, s in enumerate(eng._slots) if s}
    h0 = eng._hist[rows["h0"]].tolist()
    assert h0[:5] == prompts[0] and set(h0[5:]) == {-1}
    assert eng._hist[rows["h1"]].tolist()[:32] == prompts[1][:32]
